"""kernels (PyTorch port)."""

# the shape-class boundary: calls with M <= DECODE_M_MAX rows take the
# decode kernels and M tiles; core.execution re-exports it
DECODE_M_MAX = 8
