"""``chain_combine_batched``'s share of its roofline: each launch carries
every slot's hop (slots x payload words), at 12 bytes and 77 operations
a word (work.py), over the launches' device time."""
from perfbench import work


def read(run):
    if run.trace is None:
        return None
    n, s = run.trace.kernel(work.KERNEL_SYMBOLS["chain_combine_batched"])
    if not n or s <= 0:
        return None
    words = int(run.traffic["slots"]) * int(run.traffic["payload_words"])
    return n * work.kernel_least_seconds("chain_combine_batched", words) / s * 100
