"""Device ops of the port. Importing this package registers every
hand-written CUDA kernel (K1-K6, with the int4 entries of K3 and K4) in
`ops.cuda.KERNELS`; nothing is built or launched at import time."""

from . import cross_decode, dtw, enc_attention, enc_mlp, kv_quant, w4_matmul  # noqa: F401
