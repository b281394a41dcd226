"""The native (C++) path-matrix marcher, built with g++ at first use."""
