"""The port's parallelism over the cards of one host, over NCCL: dp, pp, sp
and tp at large-v1 full width, each held to the mesh-free calls.

    torchrun --nproc-per-node N tools/mesh_torch.py [--windows W]

Every rank runs `chip_smoke.mesh_calls` on its own card (the smoke's mesh
phase at N ranks: dp N `transcribe_batched` and `transcribe_many`, pp N and
sp N the encoder, tp N with K1, K2-partial, K3 and K4 at the rank's widths,
counted), at the headline's options over W windows of its audio (default
24, the headline's batch). Rank 0 then builds the model again whole, times
the mesh-free `transcribe_batched` (the one-card rate the mesh rates stand
beside), runs the mesh-free calls and holds every rank's results to them
(`chip_smoke.hold_mesh_ranks`), printing each card's name and power limit
and one line a rank. N must divide 20 heads, 32 layers and 1500 positions
(1, 2 or 4). Exits non-zero on any failed check. Needs N NVIDIA GPUs.
"""

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--windows", type=int, default=24, help="30 s windows of audio")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("needs CUDA devices", file=sys.stderr)
        return 2
    import torch.distributed as dist

    import chip_smoke as cs
    import whisper_at_tpu_torch as wat
    from whisper_at_tpu_torch.ops import cuda
    from whisper_at_tpu_torch.parallel.mesh import init_distributed, local_device

    cs.MESH_WINDOWS = args.windows
    init_distributed("cuda", timeout_s=cs.MESH_GROUP_TIMEOUT_S)
    rank, world = dist.get_rank(), dist.get_world_size()
    workdir = os.path.join(ROOT, "build", "mesh_torch")
    if rank == 0:
        os.makedirs(workdir, exist_ok=True)
        cards = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
        print(cards, flush=True)
        print(f"kernel build: {cuda.build_all():.1f} s", flush=True)
    dist.barrier()
    t0 = time.perf_counter()
    cs.mesh_calls(os.path.join(workdir, f"rank{rank}.pt"))
    torch.cuda.synchronize()
    dist.barrier()
    ranks_s = time.perf_counter() - t0
    dist.destroy_process_group()
    if rank != 0:
        return 0
    card = cs.card_line()
    model = wat.build_model(cs.SIZE, device=local_device(), dtype=torch.bfloat16, seed=cs.SEED)
    audio, _ = cs.mesh_audio()
    for _ in range(2):  # a warm-up, then the timed call
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        wat.transcribe_batched(model, audio, **cs.HEADLINE_OPTS)
        torch.cuda.synchronize()
        single_s = time.perf_counter() - t1
    refs = cs.mesh_references(model)
    ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
             for r in range(world)]
    print(f"mesh-free transcribe_batched on one card: {len(audio) / 16000:.0f} s audio in "
          f"{single_s:.3f} s = {len(audio) / 16000 / single_s:.2f} audio-s/s [{card}]",
          flush=True)
    cs.hold_mesh_ranks(card, model, ranks, refs, f"{world} ranks on {world} cards over NCCL")
    print(f"the ranks' calls took {ranks_s:.1f} s [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
