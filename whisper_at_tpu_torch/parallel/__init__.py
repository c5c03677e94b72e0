"""Parallelism on torch.distributed (counterpart of `whisper_at_tpu/parallel`):
meshes and transport (`mesh`), the tensor-parallel layers (`tensor`), dp and
tp inference with the services' SPMD protocol (`inference`), the GPipe
encoder (`pipeline`) and the ring-attention encoder (`sequence`). One
process a rank; see `mesh` for the programming model."""
