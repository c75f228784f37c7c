"""kernels (PyTorch port)."""

# the shape-class boundary: calls with M <= DECODE_M_MAX rows take the
# decode kernels and M tiles; core.execution re-exports it
DECODE_M_MAX = 8

# the devices on which a kernel wrapper runs its plain version: the CPU,
# and the meta device of the dry run (shapes only; launch/dryrun.py)
PLAIN_DEVICES = ("cpu", "meta")


def mac_call(m: int, k: int, n: int, products: int, weight_bytes: int):
    """A kernel call's logical work, as the op analysis reads it: (M, K,
    N, ternary products of M*K*N, bytes moved: x's int8 codes, the
    weight's bytes and the 4-byte (M, N) output)."""
    return (int(m), int(k), int(n), int(products),
            int(m) * int(k) + int(weight_bytes) + 4 * int(m) * int(n))
