"""The yardstick's arithmetic: the H100's published peaks and the work each
SAFE kernel and each round must do (a model's FLOPs sit with its plain
reference, ``reference/<name>.py``: ``train_flops``).

Frozen with the benchmark: a change that speeds the program up must not
change what its work is counted as. Every count is worked out from shapes
and the configuration's widths, never read from the program.
"""
from __future__ import annotations

# H100 SXM peaks (NVIDIA's data sheet, 700 W, dense): 3.35 TB/s of HBM3,
# 989 TFLOP/s of bf16 on the tensor cores. The issue rate bounds integer
# work: an SM issues at most one instruction per lane per clock on its 128
# lanes (4 schedulers x 32), at 132 SMs and the 1.98 GHz boost clock;
# integer adds issue on the FMA pipe as well as on the INT32 lanes, so the
# issue rate, not the INT32 pipe alone, is the bound.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
ISSUE_OPS_PER_S = 132 * 128 * 1.98e9

# A 20-round Threefry-2x32 evaluation is 72 operations (20 x add, rotate,
# xor and 12 key-injection adds) and yields two pad words.
THREEFRY_OPS = 72
ENCODE_OPS = 2     # multiply by 2^scale_bits, convert to int32 (round half even)
DECODE_OPS = 3     # convert to f32, divide by 2^scale_bits, divide by the survivors

# Per output word of each kernel: (bytes, operations). mask_add reads f32
# and writes u32, evaluates one pad (half an evaluation a word), encodes
# and adds; a hop reads the u32 cipher and the f32 row, writes u32,
# evaluates two pads, encodes, and does three ring adds.
KERNEL_WORK = {
    "mask_add": (8, THREEFRY_OPS // 2 + ENCODE_OPS + 1),
    "chain_combine": (12, THREEFRY_OPS + ENCODE_OPS + 3),
    "chain_combine_batched": (12, THREEFRY_OPS + ENCODE_OPS + 3),
}

#: The device kernels' names (the CUDA functions in the program's csrc),
#: by the name the work above is listed under.
KERNEL_SYMBOLS = {
    "mask_add": "mask_add_kernel",
    "chain_combine": "chain_combine_kernel",
    "chain_combine_batched": "chain_combine_batched_kernel",
    "bon_mask": "bon_mask_kernel",
}


def least_seconds(nbytes: float, ops: float) -> float:
    """The least time the card can take for this work: the larger of its
    bytes over HBM bandwidth and its operations over the issue rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ISSUE_OPS_PER_S)


def kernel_least_seconds(kernel: str, words: int) -> float:
    """Least time of one launch of ``kernel`` over ``words`` output words."""
    b, o = KERNEL_WORK[kernel]
    return least_seconds(b * words, o * words)


def round_work(n: int, alive: int, words: int) -> tuple:
    """(bytes, operations) of one SAFE round of n learners, ``alive`` of
    them contributing, on vectors of ``words`` words, whatever kernels
    implement it: each alive learner's f32 input read once and the f32 mean
    written once; the 2n + 1 pads the protocol has the learners make (the
    initiator's mask R, its outgoing and incoming pads, two a hop), each
    applied with one ring add, and each alive learner's encode and ring add,
    then the decode."""
    pads = 2 * n + 1
    per_word = pads * (THREEFRY_OPS // 2 + 1) + alive * (ENCODE_OPS + 1) + DECODE_OPS
    return 4 * (alive + 1) * words, per_word * words


def round_least_seconds(n: int, alive: int, words: int) -> float:
    return least_seconds(*round_work(n, alive, words))
