"""Hand-written CUDA kernels of the port: sources (``csrc/``), the loader
(``build.py``) and one wrapper per kernel with its launch counter
(``wrappers.py``).  Nothing is compiled at import."""
