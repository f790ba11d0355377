"""The streams of one run's seed: every input draws from its own seed,
``sub_seed(seed, stream, index)``, so a run's inputs do not depend on the
order they are made in.  The rows and labels of a configuration come from
its input kind, ``bench/inputs/<kind>.py``."""

from __future__ import annotations

import numpy as np
import torch

#: the input streams drawn from one run's seed
ROWS, FOREST, ORDER, KEEP, MIX, LABELS = 1, 2, 3, 4, 5, 6


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for the stream ``keys`` of the run seed ``seed``."""
    state = np.random.SeedSequence([int(seed) % 2**64, *keys]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def permutation(seed: int, stream: int, n: int) -> np.ndarray:
    return np.random.default_rng(sub_seed(seed, stream)).permutation(n)
