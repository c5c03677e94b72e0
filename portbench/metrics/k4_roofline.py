"""K4's share of its roofline, in percent: the sum of its launches' byte
bounds (`counts.k4_bound_s` at a batch's audio rows, one query row a head,
1500 valid positions, int8 codes: a layer's prefill and each forwarded
token's step read the same bytes) over the summed device time of
`cross_decode_kernel` in the profiled call. None when the launches are not
those the shapes give."""

from portbench import counts


def read(trace):
    profile = trace["profile"]
    if profile is None:
        return None
    cell, dims = trace["cell"], trace["cell"]["dims"]
    ops = [(s, e) for n, s, e in profile["ops"] if "cross_decode_kernel" in n]
    batches = counts.chunks(sum(cell["windows_per_call"]), cell["max_batch"])
    per_batch = dims["n_text_layer"] * cell["sample_len"]  # prefill + sample_len - 1 steps
    if len(ops) != per_batch * len(batches):
        return None
    bound = sum(per_batch * counts.k4_bound_s(rows, dims["n_text_head"], 1,
                                              dims["n_audio_ctx"], dims["n_text_state"])
                for rows in batches)
    return 100.0 * bound / (sum(e - s for s, e in ops) * 1e-6)
