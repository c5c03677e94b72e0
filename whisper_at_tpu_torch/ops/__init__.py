"""Device ops of the port. Importing this package registers every
hand-written CUDA kernel (K1-K4, K6) in `ops.cuda.KERNELS`; nothing is built
or launched at import time."""

from . import cross_decode, dtw, enc_attention, enc_mlp, kv_quant  # noqa: F401
