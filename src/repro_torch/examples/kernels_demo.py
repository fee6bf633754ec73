"""The masking kernels, end to end: a 4-learner chain computed entirely
with the fused kernels (the hand-written CUDA kernels on the card, their
plain PyTorch versions with ``--device cpu``), verified against the
clear-text mean.

Run: PYTHONPATH=src python -m repro_torch.examples.kernels_demo [--device cpu]
"""
import numpy as np
import torch

from repro_torch.crypto.fixedpoint import FixedPointCodec, ring_add, ring_sub
from repro_torch.crypto.prf import derive_pair_key, keystream_pair_lanes
from repro_torch.examples import device_arg
from repro_torch.kernels.ops import chain_combine, mask_add


def main(argv=None):
    device = device_arg(__doc__.splitlines()[0], argv)
    n, V = 4, 10_000
    rng = np.random.RandomState(0)
    vals = [torch.as_tensor(rng.uniform(-3, 3, V).astype(np.float32), device=device)
            for _ in range(n)]
    codec = FixedPointCodec(16)

    # Round 0 (out-of-band): pairwise hop keys + the initiator's secret
    seed = torch.tensor([2024, 8], dtype=torch.int64).to(torch.uint32)
    hop_keys = [derive_pair_key(seed, i, (i + 1) % n) for i in range(n)]
    r_key = torch.tensor([0xDEAD, 0xBEEF], dtype=torch.int64).to(torch.uint32)
    R = keystream_pair_lanes(r_key, V, 0, device=device)

    # learner 1 (initiator): fused encode+mask kernel, then add R
    cipher = ring_add(mask_add(vals[0], hop_keys[0], 0), R)
    print(f"initiator posts {cipher.numel() * cipher.element_size() / 1e6:.1f} MB ciphertext")

    # learners 2..n: ONE fused kernel per hop (decrypt+add+re-encrypt)
    for i in range(1, n):
        cipher = chain_combine(cipher, vals[i], hop_keys[i - 1], hop_keys[i], 0)
        print(f"learner {i+1} combined (kernel hop)")

    # back at the initiator: strip the last pad and R, divide
    total = ring_sub(ring_sub(cipher, keystream_pair_lanes(hop_keys[-1], V, 0, device=device)),
                     R)
    avg = codec.decode(total) / n

    truth = np.mean([v.cpu().numpy() for v in vals], axis=0)
    err = float(np.max(np.abs(avg.cpu().numpy() - truth)))
    print(f"max error vs clear-text mean: {err:.2e} "
          f"(fixed-point resolution {1/2**16:.1e})")
    if not err < 1e-3:
        raise SystemExit(f"the chain's mean is {err:.2e} from the clear-text mean")


if __name__ == "__main__":
    main()
