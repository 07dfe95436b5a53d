# Hand-written CUDA kernels (csrc/), their ctypes loader and launch
# wrappers (build, lut_eval), plain-torch versions (ref) and the dispatch
# layer (ops).
