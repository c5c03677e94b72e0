"""On-card smoke test of the PyTorch/CUDA port (whisper_at_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It (1) builds every hand-written CUDA kernel of the port from
`whisper_at_tpu_torch/csrc` (one nvcc per source, all at once), (2) holds
each kernel against its plain PyTorch version at the shapes of the headline
workload (large-v1, batch 24, bf16) and times both, (3) drives the port's
`transcribe_batched` once at large-v1 full width with random weights from a
seeded generator over synthesized int16 audio, with the kernels' launch
counts reset just before and read just after, and checks its output.

Printed, in order: the card's name and power limit (nvidia-smi), the build
time, one line per kernel check, the transcription's throughput and launch
counts, then a JSON line with every kernel's numbers and, last, the
`{"ok": true, "device": ...}` line. Any failed phase raises and exits
non-zero before the result lines. Without a CUDA card it exits non-zero at
once. `tools/profile_torch_headline.py` takes its audio and options from here.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

# published dense peaks of one H100 SXM (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# headline workload: large-v1 at full width, 24 windows of 30 s per batch
SIZE = "large-v1"
BATCH = 24
T_ENC = 1500
D = 1280
H = 20
DH = 64
TOKENS = 96
SEED = 0
# the options of the headline workload's transcribe_batched call
HEADLINE_OPTS = dict(language="en", temperature=0.0, sample_len=TOKENS, fp16=True,
                     max_batch=BATCH, logprob_threshold=None,
                     compression_ratio_threshold=None, no_speech_threshold=None,
                     kv_quant=True, weight_quant=True, self_kv_quant=True,
                     at_time_res=10)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, peak_flops: float):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check(name: str, err: float, tol: float) -> None:
    if not err <= tol:
        raise AssertionError(f"{name}: max abs err {err} > tolerance {tol}")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def kernel_checks(card: str) -> dict:
    """Each kernel against its plain version at the headline shapes."""
    from whisper_at_tpu_torch.ops import cross_decode, enc_attention, enc_mlp, kv_quant

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    def uniform(*shape, bound_=1.0):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1) * bound_).to(bf)

    rows = {}

    # ---- K1 encoder attention: q, k, v [24, 1500, 1280] -------------------- #
    q, k, v = (randn(BATCH, T_ENC, D) for _ in range(3))
    out = enc_attention.enc_attention(q, k, v, H)
    ref = enc_attention.enc_attention_plain(q, k, v, H)
    torch.cuda.synchronize()
    # one bf16 ulp of each output element (ulp <= 2^-7 |x|) plus 2^-10 absolute
    diff = (out.float() - ref.float()).abs()
    limit = 2 ** -10 + 2 ** -7 * ref.float().abs()
    worst = float((diff / limit).max())
    err = float(diff.max())
    if not worst <= 1.0:
        raise AssertionError(f"K1: |out - ref| exceeds 2^-10 + 2^-7 |ref| by {worst:.3f}x")
    tol = f"|out - ref| <= 2^-10 + 2^-7 |ref| per element, worst at {worst:.3f} of it"
    del diff, limit
    qh, kh, vh = (x.view(BATCH, T_ENC, H, DH).transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flops = 4.0 * BATCH * H * T_ENC * T_ENC * DH
    nbytes = 4.0 * BATCH * T_ENC * D * 2
    rows["K1"] = dict(
        module=enc_attention, err=err, tol=tol,
        ms=time_ms(lambda: enc_attention.enc_attention(q, k, v, H), 10),
        plain_ms=time_ms(lambda: enc_attention.enc_attention_plain(q, k, v, H), 3, 1),
        library_ms=time_ms(lambda: sdpa(qh, kh, vh), 10),
        bound=bound(flops, nbytes, PEAK_BF16_FLOPS))
    del q, k, v, out, ref, qh, kh, vh

    # ---- K2 encoder MLP half-block: x [24, 1500, 1280], 4D = 5120 ---------- #
    f = 4 * D
    x = randn(BATCH, T_ENC, D)
    ln_w = (1 + 0.1 * torch.randn(D, generator=gen, device=dev)).to(bf)
    ln_b = randn(D, scale=0.1)
    w1, b1 = uniform(f, D, bound_=D ** -0.5), uniform(f, bound_=D ** -0.5)
    w2, b2 = uniform(D, f, bound_=f ** -0.5), uniform(D, bound_=f ** -0.5)
    args = (x, ln_w, ln_b, w1, b1, w2, b2)
    out = enc_mlp.enc_mlp(*args)
    ref = enc_mlp.enc_mlp_plain(*args)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    tol = 1e-3 + 2 ** -6 * float(ref.float().abs().max())
    check("K2", err, tol)
    m = BATCH * T_ENC
    rows["K2"] = dict(
        module=enc_mlp, err=err, tol=tol,
        ms=time_ms(lambda: enc_mlp.enc_mlp(*args), 10),
        plain_ms=time_ms(lambda: enc_mlp.enc_mlp_plain(*args), 3, 1),
        library_ms=None,
        bound=bound(4.0 * m * D * f,
                    2.0 * (2 * m * D + 2 * D * f) + 4.0 * (3 * D + f),
                    PEAK_BF16_FLOPS))
    del x, args, out, ref, w1, w2

    # ---- K3 cross-KV projection + int8: xa [24, 1500, 1280] -------------- #
    xa = randn(BATCH, T_ENC, D)
    wk, wv = uniform(D, D, bound_=D ** -0.5), uniform(D, D, bound_=D ** -0.5)
    bv = uniform(D, bound_=D ** -0.5)
    kern = kv_quant.project_quantize_kv(xa, wk, wv, bv)
    plain = kv_quant.project_quantize_kv_plain(xa, wk, wv, bv)
    torch.cuda.synchronize()
    ta_pad = kv_quant.pad_ta(T_ENC)
    code_diff = torch.cat([(kern[i].int() - plain[i].int()).abs().flatten() for i in (0, 2)])
    frac = float((code_diff > 0).float().mean())
    if int(code_diff.max()) > 1 or frac > 1e-3:
        raise AssertionError(f"K3: codes differ by up to {int(code_diff.max())} "
                             f"on {frac:.2e} of entries (limit 1 LSB on 1e-3)")
    s_rel = max(float(((kern[i] - plain[i]).abs() / plain[i].clamp_min(1e-30)).max())
                for i in (1, 3))
    if s_rel > 2 ** -7:
        raise AssertionError(f"K3: scales differ by rel {s_rel} > {2 ** -7}")

    def dequant(codes, scales):
        return codes.float().view(BATCH, ta_pad, H, DH) * scales.transpose(1, 2)[..., None]

    err = max(max_err(dequant(kern[i], kern[i + 1]), dequant(plain[i], plain[i + 1]))
              for i in (0, 2))
    rows["K3"] = dict(
        module=kv_quant, err=err,
        tol=f"codes within 1 LSB on <= 1e-3 of entries (got {frac:.1e}), "
            f"scales rel <= 2^-7 (got {s_rel:.1e})",
        ms=time_ms(lambda: kv_quant.project_quantize_kv(xa, wk, wv, bv, out=kern), 10),
        plain_ms=time_ms(lambda: kv_quant.project_quantize_kv_plain(xa, wk, wv, bv), 3, 1),
        library_ms=None,
        bound=bound(2.0 * 2 * BATCH * T_ENC * D * D,
                    2.0 * BATCH * T_ENC * D + 2 * 2.0 * D * D + 2.0 * D
                    + 2 * (BATCH * ta_pad * D + 4.0 * BATCH * H * ta_pad),
                    PEAK_BF16_FLOPS))

    # ---- K4 decode-step cross-attention over K3's output ------------------ #
    kq, ks, vq, vs = kern
    bias = cross_decode.pad_bias(T_ENC, ta_pad, dev)
    errs, tols = [], []
    for groups in (4, 1):  # the prefill bucket, then the per-token steps
        qd = randn(BATCH, H * groups, DH, scale=DH ** -0.5)
        out = cross_decode.cross_attention_int8(qd, kq, ks, vq, vs, bias, H)
        ref = cross_decode.cross_attention_int8_plain(qd, kq, ks, vq, vs, bias, H)
        torch.cuda.synchronize()
        e = max_err(out, ref)
        tol = 1e-4 + 1e-3 * float(ref.abs().max())
        check(f"K4 (G={groups})", e, tol)
        errs.append(e)
        tols.append(f"G={groups}: err {e:.3e} <= {tol:.3e}")
    # timed at G=1, the per-token step; the bound reads the Ta valid positions
    # of K/V and their scales (the masked pad columns need not be read)
    rows["K4"] = dict(
        module=cross_decode, err=max(errs), tol="; ".join(tols),
        ms=time_ms(lambda: cross_decode.cross_attention_int8(qd, kq, ks, vq, vs, bias, H), 50),
        plain_ms=time_ms(lambda: cross_decode.cross_attention_int8_plain(
            qd, kq, ks, vq, vs, bias, H), 5, 1),
        library_ms=None,
        bound=bound(4.0 * BATCH * H * T_ENC * DH,
                    2 * BATCH * T_ENC * D + 2 * 4.0 * BATCH * H * T_ENC
                    + 4.0 * T_ENC + 2.0 * BATCH * H * DH + 4.0 * BATCH * H * DH,
                    PEAK_FP32_FLOPS))
    del kern, plain, kq, ks, vq, vs, xa

    for name, r in rows.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"{name} {r['module'].KERNEL.name}: max_abs_err={r['err']:.3e} "
              f"(tol {r['tol']}) kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={lib} bound_ms={r['bound'][0]:.4f} ({r['bound'][1]}) "
              f"[{card}]", flush=True)
    torch.cuda.empty_cache()
    return rows


def synth_audio(seconds: int, seed: int) -> np.ndarray:
    """int16 PCM: a 220 Hz tone with noise, as the repository's bench makes it."""
    rng = np.random.default_rng(seed)
    t = np.arange(16000 * seconds) / 16000.0
    a = 0.3 * np.sin(2 * np.pi * 220.0 * t) + 0.05 * rng.standard_normal(len(t))
    return (np.clip(a, -1.0, 1.0) * 32767.0).astype(np.int16)


def transcribe_check(card: str) -> dict:
    """The port's main path once at large-v1 full width; returns launch counts."""
    import whisper_at_tpu_torch as wat
    from whisper_at_tpu_torch.ops import cuda

    model = wat.build_model(SIZE, device="cuda", dtype=torch.bfloat16, seed=SEED)
    audio = synth_audio(BATCH * 30, SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wat.transcribe_batched(model, audio, **HEADLINE_OPTS)  # warm-up: allocator, library handles
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    result = wat.transcribe_batched(model, audio, **HEADLINE_OPTS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = cuda.launch_counts()

    tags = np.asarray(result["audio_tag"])
    n_cells = -(-len(audio) // (16000 * 10))
    if tags.shape != (n_cells, 527) or not np.isfinite(tags).all():
        raise AssertionError(f"audio_tag has shape {tags.shape} or non-finite values")
    if np.abs(tags).sum(axis=1).min() <= 0:
        raise AssertionError("a tag cell was never written")
    for seg in result["segments"]:
        if not 0 <= seg["start"] <= seg["end"]:
            raise AssertionError(f"segment times out of order: {seg}")
        if not np.isfinite(seg["avg_logprob"]):
            raise AssertionError(f"non-finite avg_logprob: {seg}")
    missing = [name for name, n in counts.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    print(f"transcribe_batched {SIZE} batch {BATCH}: {len(audio) / 16000:.0f} s audio "
          f"in {seconds:.3f} s = {len(audio) / 16000 / seconds:.2f} audio-s/s "
          f"(second call; the first took {warm_s:.3f} s), {len(result['segments'])} segments, "
          f"tags {tags.shape}, launches {counts} [{card}]", flush=True)
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from whisper_at_tpu_torch.ops import cuda

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    build_s = cuda.build_all()
    print(f"kernel build: {build_s:.1f} s for {len(cuda.KERNELS)} kernels [{card}]",
          flush=True)
    for kernel in cuda.KERNELS.values():
        regs = [ln.strip() for ln in kernel.build_log().splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"ptxas {kernel.name}: {' | '.join(regs)}", flush=True)

    rows = kernel_checks(card)
    counts = transcribe_check(card)

    line = {"kernels": [
        {"name": name,
         "route": "cuda",
         "source": f"whisper_at_tpu_torch/csrc/{r['module'].KERNEL.source}",
         "replaces": r["module"].KERNEL.replaces,
         "launches": counts[r["module"].KERNEL.name],
         "max_abs_err": r["err"],
         "ms": r["ms"],
         "plain_ms": r["plain_ms"],
         "bound_ms": r["bound"][0],
         "bound_by": r["bound"][1],
         "library_ms": r["library_ms"]}
        for name, r in rows.items()]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
