"""``chain_combine``'s share of its roofline: the launches' least time
(12 bytes and 77 operations a word, work.py) over their device time."""
from perfbench import work


def read(run):
    if run.trace is None:
        return None
    n, s = run.trace.kernel(work.KERNEL_SYMBOLS["chain_combine"])
    if not n or s <= 0:
        return None
    words = int(run.traffic["payload_words"])
    return n * work.kernel_least_seconds("chain_combine", words) / s * 100
