"""Device ops of the port. Importing this package registers every
hand-written CUDA kernel (K1-K10, with the int4 entries of K3, K4 and K10
and the int8 entry of K8, and the streaming probes P1 and P2) in
`ops.cuda.KERNELS`; nothing is built or launched at import time. The mel
filterbank is re-exported as the JAX package's `ops` does."""

from . import (  # noqa: F401
    cross_decode,
    cross_decode_stream,
    dtw,
    enc_attention,
    enc_flash,
    enc_mlp,
    flash_decode,
    fused_mlp,
    kv_quant,
    probe_dma,
    w4_matmul,
)
from .mel import mel_filters  # noqa: F401
