"""GF(2^8) arithmetic: numpy tables, torch ops, the CUDA encode kernel."""
