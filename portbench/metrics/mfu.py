"""The calls' share of the card's bf16 peak, in percent: 2 x the
multiply-accumulates of every product of the traced run's plain calls
(encoder, cross K/V, decoder at the tokens each window emitted, TL-TR; a
window that returned no segment counted at sample_len tokens, which it
decoded) over their wall time, over 989 TFLOP/s (`counts`)."""

from portbench import counts


def read(trace):
    cell, window = trace["cell"], trace["window"]
    dims, prompt = cell["dims"], cell["prompt_len"]
    tokens = list(window["window_tokens"])
    tokens += [cell["sample_len"]] * (window["windows"] - len(tokens))
    macs = sum(counts.window_macs(dims, cell["at_mode"], prompt, n) for n in tokens)
    return counts.mfu_percent(macs, window["wall_s"])
