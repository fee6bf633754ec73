"""The whole step's share of the card's bf16 peak: the model FLOPs of the
window's steps (the reference's ``train_flops``) over the window, against
989 TFLOP/s."""
from perfbench.work import BF16_FLOPS_PER_S


def read(run):
    if run.trace is None or run.window_s <= 0 or run.flops <= 0:
        return None
    return run.flops / run.window_s / BF16_FLOPS_PER_S * 100
