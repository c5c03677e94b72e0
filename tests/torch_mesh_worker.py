"""Rank processes of the port's mesh tests (`test_torch_parallel*.py`).

The test process (which holds the JAX package) writes a payload of weights
and inputs and starts one process a rank with `run_ranks`. Each rank imports
torch, numpy and the port only, joins a gloo group through a file under the
test's temporary directory (no TCP port, so parallel test workers never
collide), runs every case of its suite, and saves {case: ("ok", value) or
("error", traceback)}. Every group has a 60 s timeout, and the parent kills
the ranks and fails once its deadline passes, so a hung collective cannot
hang the suite.

    python tests/torch_mesh_worker.py RANK WORLD WORKDIR SUITE
"""

import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 60.0


def run_ranks(world: int, suite: str, payload, workdir, deadline_s: float = 240.0) -> list:
    """Run `suite` in `world` rank processes on `payload`; returns each
    rank's results, in rank order. Raises (after killing every rank) when
    a rank fails to finish by the deadline or exits non-zero."""
    import torch

    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    torch.save(payload, os.path.join(workdir, "payload.pt"))
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("LOCAL_RANK", None)
    procs, logs = [], []
    for rank in range(world):
        log = open(os.path.join(workdir, f"rank{rank}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(rank), str(world), workdir, suite],
            env=env, stdout=log, stderr=subprocess.STDOUT, cwd=ROOT))
    end = time.monotonic() + deadline_s
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > end:
                raise TimeoutError(f"{suite} on {world} ranks passed its {deadline_s:.0f} s "
                                   f"deadline")
            time.sleep(0.05)
    except BaseException as exc:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        raise RuntimeError(_logs(workdir, world)) from exc
    finally:
        for log in logs:
            log.close()
    if any(p.returncode for p in procs):
        raise RuntimeError(f"rank exit codes {[p.returncode for p in procs]}\n"
                           + _logs(workdir, world))
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _logs(workdir: str, world: int) -> str:
    out = []
    for r in range(world):
        path = os.path.join(workdir, f"rank{r}.log")
        if os.path.exists(path):
            with open(path) as f:
                out.append(f"--- rank {r} ---\n{f.read()[-4000:]}")
    return "\n".join(out)


def value(results: list, case: str, rank: int = 0):
    """A case's value on one rank; fails with the rank's traceback when the
    case raised there."""
    status, got = results[rank][case]
    if status != "ok":
        raise AssertionError(f"{case} failed on rank {rank}:\n{got}")
    return got


# ---------------------------------------------------------------------- #
# the rank side
# ---------------------------------------------------------------------- #

def _model(payload, key="model"):
    import whisper_at_tpu_torch as wat

    spec = payload[key]
    model = wat.Whisper(wat.ModelDimensions(**spec["dims"]))
    model.load_state_dict(spec["state"])
    return model.eval()


def _result_summary(result: dict) -> dict:
    return dict(text=result["text"], audio_tag=result["audio_tag"],
                tokens=[s["tokens"] for s in result["segments"]],
                avg_logprob=[s["avg_logprob"] for s in result["segments"]])


def _decode_summary(r) -> dict:
    return dict(tokens=list(r.tokens), avg_logprob=float(r.avg_logprob))


def case_mesh_shapes(payload):
    from whisper_at_tpu_torch.parallel.mesh import make_mesh

    shapes = {}
    for tp in (1, 2):
        mesh = make_mesh(tp=tp, device="cpu")
        shapes[tp] = (mesh.shape, mesh.coords, mesh.ranks)
    try:
        make_mesh(dp=3, tp=2, device="cpu")
        refused = False
    except ValueError:
        refused = True
    return dict(shapes=shapes, refused=refused)


def case_batch_slices(payload):
    import numpy as np
    import torch

    from whisper_at_tpu_torch.parallel.inference import dp_share, shard_windows
    from whisper_at_tpu_torch.parallel.mesh import make_mesh, shard_batch

    mesh = make_mesh(device="cpu")
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    return dict(batch=shard_batch(mesh, x), pair=shard_batch(mesh, {"a": torch.arange(8)})["a"],
                share=dp_share(list(range(7)), mesh),
                windows=shard_windows(mesh, torch.arange(5)).tolist())


def case_dp_transcribe(payload):
    import whisper_at_tpu_torch as wat
    from whisper_at_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    model = _model(payload)
    out = {}
    for name, (audio, kwargs) in payload["transcribe"].items():
        out[name] = _result_summary(wat.transcribe_batched(model, audio, mesh=mesh, **kwargs))
    return out


def case_dp_transcribe_many(payload):
    import whisper_at_tpu_torch as wat
    from whisper_at_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    model = _model(payload)
    audios, kwargs = payload["many"]
    return [_result_summary(r) for r in wat.transcribe_many(model, audios, mesh=mesh, **kwargs)]


def case_tp_decode(payload):
    import torch

    import whisper_at_tpu_torch as wat
    from whisper_at_tpu_torch.parallel.inference import place_model_tp
    from whisper_at_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(tp=2, device="cpu")
    model = place_model_tp(_model(payload), mesh)
    mel = torch.from_numpy(payload["mel"])
    feats, taps = model.embed_audio(mel, fp16=False)
    out = dict(features=feats, taps=taps, heads=(model.text_heads, model.audio_heads),
               qkv=tuple(model.decoder_params_decode().blocks[0].attn.qkv.weight.shape))
    for name, options in payload["decode"].items():
        out[name] = _decode_summary(wat.decode(model, mel[0], wat.DecodingOptions(**options)))
    words_audio, words_kwargs = payload["tp_words"]
    out["words"] = [[(w["word"], w["start"], w["end"]) for w in s["words"]]
                    for s in wat.transcribe_batched(model, words_audio, mesh=mesh,
                                                    **words_kwargs)["segments"]]
    return out


def case_pp_encoder(payload):
    import torch

    from whisper_at_tpu_torch.parallel.pipeline import encoder_apply_pp, make_pp_mesh

    mesh = make_pp_mesh(device="cpu")
    encoder = _model(payload, "encoder_model").encoder
    mel = torch.from_numpy(payload["enc_mel"])
    n_head = payload["encoder_model"]["dims"]["n_audio_head"]
    return {m: encoder_apply_pp(encoder, mel, mesh, n_head, n_micro=m)
            for m in (None, 2)}


def case_sp_encoder(payload):
    import torch

    from whisper_at_tpu_torch.parallel.sequence import encoder_apply_sp, make_sp_mesh

    mesh = make_sp_mesh(device="cpu")
    encoder = _model(payload, "encoder_model").encoder
    mel = torch.from_numpy(payload["enc_mel"][:2])
    n_head = payload["encoder_model"]["dims"]["n_audio_head"]
    return encoder_apply_sp(encoder, mel, mesh, n_head)


def case_services(payload):
    import whisper_at_tpu_torch as wat
    from whisper_at_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    model = _model(payload)
    audios, kwargs = payload["many"]
    options = {k: v for k, v in kwargs.items() if k != "max_batch"}
    out = {}
    service = wat.TranscriptionService(model, mesh=mesh, max_batch=kwargs["max_batch"],
                                       max_wait_s=0.5, **options)
    if mesh.rank == 0:
        futures = [service.submit(a) for a in audios]
        out["serving"] = [_result_summary(f.result(timeout=120)) for f in futures]
    else:
        try:
            service.submit(audios[0])
        except RuntimeError:
            out["refused"] = True
    service.close()
    stream_audio, stream_options = payload["stream"]
    streams = wat.StreamingService(model, mesh=mesh, max_batch=4)
    if mesh.rank == 0:
        session = streams.open(**stream_options)
        for lo in range(0, len(stream_audio), 16000 * 7):
            session.feed(stream_audio[lo:lo + 16000 * 7])
        result = session.finish()
        out["streaming"] = dict(text=result["text"],
                                tokens=[s["tokens"] for s in result["segments"]])
    streams.close()
    return out


def case_train_step(payload):
    import torch

    from whisper_at_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from whisper_at_tpu_torch.train.steps import make_sharded_train_step
    from whisper_at_tpu_torch.train.tltr import TLTR

    spec = payload["tltr"]
    out = {}
    for dp, tp in spec["meshes"][int(os.environ["WORLD"])]:
        mesh = make_mesh(dp=dp, tp=tp, device="cpu")
        head = TLTR(*spec["shape"], mode=spec["mode"])
        head.load_state_dict(spec["state"])
        step, head, _ = make_sharded_train_step(mesh, spec["mode"], head, spec["lr"],
                                                compute_dtype=torch.float32)
        feats = shard_batch(mesh, torch.from_numpy(spec["feats"]))
        labels = shard_batch(mesh, torch.from_numpy(spec["labels"]))
        losses = [float(step(head, feats, labels, 1.0)) for _ in range(spec["steps"])]
        out[(dp, tp)] = dict(losses=losses,
                             shapes={n: tuple(p.shape) for n, p in head.named_parameters()})
    return out


def case_train_loop(payload):
    import torch

    from whisper_at_tpu_torch import train as pt
    from whisper_at_tpu_torch.parallel.mesh import make_mesh
    from whisper_at_tpu_torch.train.tltr import TLTR

    spec = payload["loop"]
    dp, tp = spec["meshes"][int(os.environ["WORLD"])]
    mesh = make_mesh(dp=dp, tp=tp, device="cpu")
    head = TLTR(*spec["shape"], mode=spec["mode"])
    head.load_state_dict(spec["state"])
    data = pt.FeatureDataset(spec["train_json"], spec["conf"], spec["label_csv"])
    loaders = (pt.DataLoader(data, batch_size=8, shuffle=True, num_workers=2),
               pt.DataLoader(data, batch_size=8, num_workers=2))
    report = {}
    pt.train(head, spec["mode"], *loaders, exp_dir=spec["exp_dir"], lr=spec["lr"],
             n_epochs=spec["epochs"], dataset="tiny", n_print_steps=1000,
             compute_dtype=torch.float32, mesh=mesh, report=report)
    return report


SUITES = {
    "parallel2": [case_mesh_shapes, case_batch_slices, case_dp_transcribe,
                  case_dp_transcribe_many, case_tp_decode, case_pp_encoder, case_sp_encoder,
                  case_services],
    "parallel4": [case_mesh_shapes, case_dp_transcribe, case_tp_decode, case_pp_encoder,
                  case_sp_encoder],
    "train": [case_train_step, case_train_loop],
}


def main(argv) -> int:
    rank, world, workdir, suite = int(argv[0]), int(argv[1]), argv[2], argv[3]
    os.environ["WORLD"] = str(world)
    import torch

    torch.set_num_threads(1)
    from whisper_at_tpu_torch.parallel.mesh import init_distributed

    init_distributed("cpu", init_method=f"file://{os.path.join(workdir, 'rendezvous')}",
                     world_size=world, rank=rank, timeout_s=GROUP_TIMEOUT_S)
    payload = torch.load(os.path.join(workdir, "payload.pt"), weights_only=False)
    out = {}
    for case in SUITES[suite]:
        t0 = time.monotonic()
        try:
            out[case.__name__[5:]] = ("ok", case(payload))
        except Exception:  # noqa: BLE001 - reported to the test, which fails on it
            out[case.__name__[5:]] = ("error", traceback.format_exc())
        print(f"rank {rank}: {case.__name__} {time.monotonic() - t0:.2f} s", flush=True)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
