"""The streaming probes P1 and P2 of the port (`whisper_at_tpu_torch/ops/
probe_dma.py`, `tools/probe_dma_torch.py`) against the JAX probe
`tools/probe_dma.py`.

The JAX probe runs unmodified, in interpret mode on the CPU, through its
own `main()`; its results are taken where it pulls them to the host
(`jax.tree.map(np.asarray, ...)`) and its buffer where it hands the numpy
draw to `jnp.asarray`. With `--iters 1` it pulls each variant twice (the
compile run and the timed run): the `xla` scalar, then `auto`, `manual-2`,
`manual-4` and `manual-8`, each [1, 128] int32. On the CPU the port's
wrappers run the plain version, so every comparison here is exact.
"""

import functools
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_at_tpu_torch.ops import probe_dma as pd

pytestmark = pytest.mark.quick

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (mb, chunk_kb): 8 chunks, as many as the deepest ring; 4 chunks, fewer
GEOMETRIES = [(2, 256), (1, 256)]
VARIANTS = ["auto"] + [f"{engine}-{n}" for engine in pd.ENGINES for n in pd.RING_DEPTHS]


def _load(name: str, path: str):
    saved = list(sys.path)  # the scripts put their own directories on sys.path
    try:
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = saved
    return module


@functools.lru_cache(maxsize=None)
def jax_probe(mb: int, chunk_kb: int):
    """(the buffer, {"xla": scalar, "auto": [1, 128], "manual-N": ...}) of
    one run of the JAX probe's main() at this geometry."""
    module = _load("probe_dma_jax", os.path.join(ROOT, "tools", "probe_dma.py"))
    pulled, buffers = [], []
    tree_map, asarray = jax.tree.map, jnp.asarray

    def recording_map(f, tree, *rest, **kwargs):
        if f is np.asarray:
            pulled.append(np.asarray(tree))
        return tree_map(f, tree, *rest, **kwargs)

    def recording_asarray(a, *args, **kwargs):
        if isinstance(a, np.ndarray) and a.dtype == np.int8:
            buffers.append(a.copy())
        return asarray(a, *args, **kwargs)

    argv = sys.argv
    sys.argv = ["probe_dma.py", "--cpu", "--mb", str(mb), "--chunk-kb", str(chunk_kb),
                "--iters", "1"]
    jax.tree.map, jnp.asarray = recording_map, recording_asarray
    try:
        module.main()
    finally:
        jax.tree.map, jnp.asarray = tree_map, asarray
        sys.argv = argv
    names = ["xla", "auto", "manual-2", "manual-4", "manual-8"]
    assert len(pulled) == 2 * len(names) and len(buffers) == 1
    for i in range(len(names)):
        np.testing.assert_array_equal(pulled[2 * i], pulled[2 * i + 1])
    return buffers[0], {name: pulled[2 * i] for i, name in enumerate(names)}


def _run(x: torch.Tensor, chunk_rows: int, variant: str):
    if variant == "auto":
        return pd.stream_auto(x, chunk_rows)
    engine, nbuf = variant.rsplit("-", 1)
    return pd.stream_ring(x, chunk_rows, int(nbuf), engine)


@pytest.mark.parametrize("mb, chunk_kb", [(512, 1024), (2, 256), (1, 256), (5, 2048),
                                          (1, 24), (7, 3072), (3, 8), (1, 1024)])
def test_geometry_matches_the_jax_arithmetic(mb, chunk_kb):
    """The JAX probe's rounding (`tools/probe_dma.py:53-56`), including
    sizes that round down to whole chunks (5 MiB in 2 MiB chunks, 1 MiB in
    24 KiB chunks, 7 MiB in 3 MiB chunks)."""
    rows = mb * (1 << 20) // 128
    chunk_rows = chunk_kb * (1 << 10) // 128
    rows = rows // chunk_rows * chunk_rows
    assert pd.probe_geometry(mb, chunk_kb) == (rows, chunk_rows, rows // chunk_rows)


@pytest.mark.parametrize("mb, chunk_kb", [(8, 4), (8, 7), (1, 2048), (0, 256)])
def test_geometry_refuses_the_jax_quirks(mb, chunk_kb):
    """Chunks under the 8 KB sliver (where the JAX probe's P1 clips the
    sliver and its P2 reads into the next slot) and buffers without a whole
    chunk (n_chunks = 0) raise."""
    with pytest.raises(ValueError):
        pd.probe_geometry(mb, chunk_kb)


@pytest.mark.parametrize("mb, chunk_kb", GEOMETRIES)
def test_make_buffer_is_the_jax_probe_buffer(mb, chunk_kb):
    buffer, _ = jax_probe(mb, chunk_kb)
    rows, _, _ = pd.probe_geometry(mb, chunk_kb)
    x = pd.make_buffer(rows)
    assert x.dtype == torch.int8 and x.shape == buffer.shape
    assert x.numpy().tobytes() == buffer.tobytes()


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("mb, chunk_kb", GEOMETRIES)
def test_probe_matches_the_jax_probe(mb, chunk_kb, variant):
    """P1 against the JAX `auto`, P2 (both engines) against `manual-N` at
    the same depth, exactly; the XOR word against numpy's over the int32
    view."""
    buffer, ref = jax_probe(mb, chunk_kb)
    rows, chunk_rows, _ = pd.probe_geometry(mb, chunk_kb)
    sums, xor = _run(pd.make_buffer(rows), chunk_rows, variant)
    want = ref["auto" if variant == "auto" else "manual-" + variant.rsplit("-", 1)[1]]
    assert sums.dtype == torch.int32 and sums.shape == (1, 128)
    np.testing.assert_array_equal(sums.numpy(), want)
    assert xor.dtype == torch.int32 and xor.shape == (1,)
    assert int(xor) == int(np.bitwise_xor.reduce(buffer.reshape(-1).view(np.int32)))


@pytest.mark.parametrize("mb, chunk_kb", GEOMETRIES)
def test_library_sum_matches_the_xla_row(mb, chunk_kb):
    _, ref = jax_probe(mb, chunk_kb)
    rows, _, _ = pd.probe_geometry(mb, chunk_kb)
    total = torch.sum(pd.make_buffer(rows), dtype=torch.int32)
    assert total.dtype == torch.int32 and int(total) == int(ref["xla"])


@pytest.mark.parametrize("n_words", [1, 2, 3, 7, 32, 33, 1000, 4096 * 3 + 5])
def test_xor_words_plain_matches_numpy(n_words):
    """The halving loop, including odd word counts at some of its steps."""
    x = torch.from_numpy(np.random.default_rng(n_words).integers(
        -128, 128, 4 * n_words, dtype=np.int8))
    want = np.bitwise_xor.reduce(x.numpy().view(np.int32))
    got = pd.xor_words_plain(x)
    assert got.dtype == torch.int32 and got.shape == (1,) and int(got) == int(want)


@pytest.mark.parametrize("chunk_kb, want", [(1024, (65536, 32768, 16384)),
                                            (8, (8192, 8192, 8192)),
                                            (12, (4096, 4096, 4096)),
                                            (24, (8192, 8192, 8192)),
                                            (48, (16384, 16384, 16384))])
def test_stage_bytes(chunk_kb, want):
    """A stage divides the chunk, is a power of two of whole rows, and the
    ring of N stages fits in RING_BYTES."""
    chunk_rows = chunk_kb * 1024 // pd.LANES
    got = tuple(pd.stage_bytes(chunk_rows, n) for n in pd.RING_DEPTHS)
    assert got == want
    for n, stage in zip(pd.RING_DEPTHS, got):
        assert (chunk_kb * 1024) % stage == 0 and stage % pd.LANES == 0
        assert n * stage <= pd.RING_BYTES


@pytest.mark.parametrize("call, error", [
    (lambda x: pd.stream_auto(x[:, :64], 64), "int8"),
    (lambda x: pd.stream_auto(x.int(), 64), "int8"),
    (lambda x: pd.stream_auto(x[:100], 64), "whole number"),
    (lambda x: pd.stream_auto(x, 32), "whole number"),
    (lambda x: pd.stream_ring(x, 64, 3, "tma"), "nbuf"),
    (lambda x: pd.stream_ring(x, 64, 4, "dma"), "engine"),
])
def test_wrappers_refuse_bad_input(call, error):
    with pytest.raises(ValueError, match=error):
        call(pd.make_buffer(128))


def test_tool_runs_the_plain_versions_on_the_cpu(capsys):
    """`tools/probe_dma_torch.py --cpu` prints one row per variant, each
    checked against the plain version and numpy, with host times only."""
    tool = _load("probe_dma_torch", os.path.join(ROOT, "tools", "probe_dma_torch.py"))
    assert tool.main(["--cpu", "--mb", "1", "--chunk-kb", "256", "--iters", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("buffer 1048576 B int8 [8192, 128], 4 chunks")
    assert [ln.split()[0] for ln in lines[1:]] == list(tool.VARIANTS)
    assert all("on the CPU" in ln and "GB/s" not in ln for ln in lines[1:])
    with pytest.raises(ValueError):
        tool.main(["--cpu", "--chunk-kb", "4"])
