"""K2's share of its roofline, in percent: the sum of its launches'
bounds at the call's shapes (`counts.k2_bound_s`: one launch a layer a
batch of windows, rows = windows x 1500) over the summed device time of its
kernels in the profiled call (`ln_rows`, then the `gemm_kernel` of fc1
with the `BiasGelu` epilogue and of fc2 with `BiasResidual`). None when the
launches are not those the shapes give."""

from portbench import counts

NAMES = ("ln_rows", "BiasGelu", "BiasResidual")


def read(trace):
    profile = trace["profile"]
    if profile is None:
        return None
    cell, dims = trace["cell"], trace["cell"]["dims"]
    fc1 = [1 for n, _, _ in profile["ops"] if "BiasGelu" in n]
    device_s = sum(e - s for n, s, e in profile["ops"] if any(k in n for k in NAMES)) * 1e-6
    batches = counts.chunks(sum(cell["windows_per_call"]), cell["max_batch"])
    if len(fc1) != dims["n_audio_layer"] * len(batches) or device_s <= 0:
        return None
    bound = sum(dims["n_audio_layer"] * counts.k2_bound_s(rows * dims["n_audio_ctx"],
                                                           dims["n_audio_state"])
                for rows in batches)
    return 100.0 * bound / device_s
