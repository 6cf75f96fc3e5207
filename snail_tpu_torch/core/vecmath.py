"""Constants shared by the port (``snail_tpu.core.vecmath``)."""

# Large-but-finite stand-in for +inf where inf would poison arithmetic
# (0 * inf = nan): the miss distance and the masked-ray sentinel.
BIG = 3.4e37

# Bias of the inverse ray direction, 1 / (d + INV_EPS): the reference's
# SafeInv (rtbase.h:117-120), as every traversal kernel computes it.
INV_EPS = 1e-8
