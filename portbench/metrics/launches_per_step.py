"""Device kernels a decode step, counted inside the greedy loop of the
profiled call: the kernels that start from a decode batch's first
cross-attention launch (K4, `cross_decode_kernel`, layer 0 of the prefill)
to its last step's first, over the steps between them. Each K4 launch is
one layer of one step, so a batch holds n_text_layer x sample_len of them
(the prefill and sample_len - 1 steps). The encoder, K3, the tags and the
frontend lie outside every such span. Copies and fills are not kernels and
are not counted. None when the K4 launches are not those the shapes give."""


def read(trace):
    profile, cell = trace["profile"], trace["cell"]
    if profile is None:
        return None
    layers, sample_len = cell["dims"]["n_text_layer"], cell["sample_len"]
    per_batch = layers * sample_len
    k4 = sorted(s for n, s, _ in profile["ops"] if "cross_decode_kernel" in n)
    if not k4 or len(k4) % per_batch or sample_len < 2:
        return None
    starts = sorted(s for n, s, _ in profile["ops"] if not n.startswith(("Memcpy", "Memset")))
    kernels = steps = 0
    for b in range(0, len(k4), per_batch):
        lo, hi = k4[b], k4[b + (sample_len - 1) * layers]
        kernels += sum(1 for s in starts if lo <= s < hi)
        steps += sample_len - 1
    return kernels / steps
