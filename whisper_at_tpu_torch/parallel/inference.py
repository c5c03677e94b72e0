"""Inference over a mesh: dp replicas that split the windows, tp ranks that
split every block, and the SPMD protocol of the services.

Counterpart of `whisper_at_tpu/parallel/inference.py`.

dp  `transcribe_batched(mesh=)` and `transcribe_many(mesh=)` give every
    rank the same audio. Each rung of the temperature ladder splits its
    pending windows into dp contiguous shares (`dp_share`); a rank decodes
    its share through K1-K4 in chunks of max_batch / dp, exactly its
    windows (the JAX package pads each batch to a multiple of dp for
    GSPMD; the dp ranks here share no collective inside a decode, so
    nothing is padded). The results are then gathered (`gather_results`)
    and every rank goes on with all of them: it returns the same dict,
    windows, segments and tags, as the one JAX result.
tp  `place_model_tp` splits each encoder and decoder block in place
    (`parallel.tensor.split_block`): q, k, v and fc1 by output columns (the
    rank's heads), out and fc2 by input rows, one all_reduce after each
    row-split product. The conv stem, LNs, embeddings and the TL-TR head
    stay whole. The kernels stay on the path at the rank's widths: K1 and
    K4 over its H / tp heads, K2-partial over its 4D / tp hidden units, K3
    over its [D / tp, D] weights. (The JAX package leaves its Pallas
    kernels under a mesh only because Mosaic calls cannot be partitioned.)

Services (`TranscriptionService(mesh=)`, `StreamingService(mesh=)`): only
rank 0 owns the queue, the scheduler and the HTTP front end. Before each
batch it broadcasts the batch's inputs and options (`lead`); the other
ranks wait in `follow`, make the same collective call on what they receive,
and leave when rank 0 broadcasts the end (`close()` on rank 0 sends it).
"""

from typing import Callable, Optional

from .mesh import Mesh, as_mesh, broadcast_object, gather_objects, make_mesh, replicate_params
from .tensor import TP, split_block

_END, _IDLE = "end", "idle"


def place_model_on_mesh(model, mesh: Mesh, broadcast: bool = True):
    """Replicate the model over the mesh (every parameter and buffer
    overwritten with rank 0's, unless broadcast=False for ranks that built
    identical weights) and record the mesh. A model already on this mesh is
    left as it is. Returns the model."""
    mesh = as_mesh(mesh)
    if getattr(model, "_mesh", None) is mesh:
        return model
    if model.tp is not None:
        raise ValueError("the model is split over another mesh's tp axis")
    if broadcast:
        replicate_params(mesh, model)
    model._decode_params = {}
    model._mesh = mesh
    return model


def shard_windows(mesh: Mesh, windows):
    """This rank's dp share of a [W, 80, 3000] window batch (contiguous,
    the first W % dp ranks one window more)."""
    idx = dp_share(list(range(windows.shape[0])), as_mesh(mesh))
    return windows[idx[0]:idx[-1] + 1] if idx else windows[:0]


def infer_mesh(model) -> Optional[Mesh]:
    return getattr(model, "_mesh", None)


def auto_mesh_for_inference(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """Every rank a dp replica (the throughput placement: large-v2 fits one
    card in bf16). For latency use a tp > 1 mesh and `place_model_tp`: the
    decode loop streams its weights and K/V every step, and tp divides
    them."""
    return make_mesh(n_devices=n_devices, tp=1, device=device)


def share(n: int, parts: int, index: int) -> slice:
    """Part `index` of n items in `parts` contiguous parts: n // parts
    each, the first n % parts one more."""
    per, extra = divmod(n, parts)
    lo = index * per + min(index, extra)
    return slice(lo, lo + per + (1 if index < extra else 0))


def dp_share(items: list, mesh: Mesh) -> list:
    """This rank's contiguous share of `items` over dp (`share`)."""
    return items[share(len(items), mesh.size("dp"), mesh.coord("dp"))]


def gather_results(local: list, mesh: Mesh) -> list:
    """Every dp rank's results, in rank order (the order of `dp_share`),
    on every rank."""
    return [r for part in gather_objects(local, mesh, "dp") for r in part]


# ---------------------------------------------------------------------- #
# tensor-parallel placement
# ---------------------------------------------------------------------- #

def place_model_tp(model, mesh: Mesh, broadcast: bool = True):
    """Split the model's encoder and decoder blocks over the mesh's tp axis,
    in place (the Megatron rules of `_block_leaf_spec`: q / k / v and fc1
    by output columns, their biases and int8 scales with them; out and fc2
    by input rows, their biases and scales whole). Requires tp to divide
    n_text_head and n_audio_head. With broadcast, rank 0's weights are
    first copied to every rank. Returns the model."""
    mesh = as_mesh(mesh)
    tp = mesh.size("tp")
    dims = model.dims
    if dims.n_text_head % tp or dims.n_audio_head % tp:
        raise ValueError(f"tp={tp} must divide n_text_head={dims.n_text_head} and "
                         f"n_audio_head={dims.n_audio_head}")
    if model.tp is not None:
        raise ValueError("the model is already split over a tp axis")
    if broadcast:
        replicate_params(mesh, model)
    axis = TP(mesh)
    for block in list(model.encoder.blocks) + list(model.decoder.blocks):
        split_block(block, axis)
    model.tp = axis
    model._decode_params = {}
    model._mesh = mesh
    return model


# ---------------------------------------------------------------------- #
# the services' SPMD protocol
# ---------------------------------------------------------------------- #

def lead(mesh: Mesh, job) -> None:
    """Rank 0: send the next job (a tuple) to every other rank."""
    broadcast_object(job, mesh)


def heartbeat(mesh: Mesh) -> None:
    """Rank 0, while idle: a job the others skip, so that their waits in
    `follow` end within the groups' timeout."""
    broadcast_object((_IDLE,), mesh)


def end(mesh: Mesh) -> None:
    """Rank 0: release every rank waiting in `follow`."""
    broadcast_object((_END,), mesh)


def follow(mesh: Mesh, run: Callable) -> None:
    """Ranks other than 0: run(job) for each job rank 0 leads, until it
    ends. A job whose inputs or options are refused (ValueError, TypeError)
    is refused on rank 0 too, the same call on the same inputs, which
    reports it to its callers: the follower goes on. Any other error (a
    collective that failed or timed out) ends the follower and is raised."""
    mesh.bind_thread()
    while True:
        job = broadcast_object(None, mesh)
        if job[0] == _END:
            return
        if job[0] == _IDLE:
            continue
        try:
            run(job)
        except (ValueError, TypeError):
            continue


__all__ = [
    "auto_mesh_for_inference", "dp_share", "end", "follow", "gather_results", "heartbeat",
    "infer_mesh", "lead", "place_model_on_mesh", "place_model_tp", "share", "shard_windows",
]
