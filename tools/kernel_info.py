"""What the compiler made of a kernel library: demangled names, ``ptxas -v``'s
registers and spills, and ``cuobjdump -sass``'s machine code per kernel
(``chip_smoke.demangle`` and ``sass_functions``).

Shared by the design tools (``tools/*_designs.py``), which run on a machine
with the CUDA toolkit; nothing of the port imports it.
"""

from __future__ import annotations

import re

from chip_smoke import demangle, sass_functions  # noqa: F401  (exits without a CUDA device)


def ptxas_lines(log):
    """The registers, stack and spills ``ptxas -v`` reported for each kernel."""
    lines, entry = [], None
    for line in demangle(log).splitlines():
        line = line.strip()
        m = re.search(r"Compiling entry function '(.*)' for", line)
        if m:
            entry = m.group(1)
        elif entry and ("registers" in line or "stack frame" in line):
            lines.append(f"{entry}: {line.split(':', 1)[-1].strip()}")
    return lines
