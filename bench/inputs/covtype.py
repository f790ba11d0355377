"""Rows of UCI Covertype's shape, (n, 54) float32: 10 continuous terrain
features mixed from 6 latent ones (elevation- and slope-like columns scaled
as the data's), 4 one-hot wilderness areas and 40 one-hot soil types that
follow the first latent feature; labels are 7 cover classes cut at the
chunk's quantiles of a terrain score.  The formulas of ``make_covtype(...,
multiclass=True)`` in the program's ``data/synth.py`` (its seed's numpy
stream aside).  The latent mix is one per seed, shared by every chunk."""

from __future__ import annotations

import torch

from bench.core import seeds

#: class boundaries, as quantiles of the terrain score
CLASS_QUANTILES = (0.2, 0.45, 0.6, 0.75, 0.85, 0.95)


def draw(seed: int, chunk: int, n: int, d: int, device, labels: bool = False):
    if d != 54:
        raise ValueError(f"covtype rows have 54 features, not {d}")
    gen = seeds.generator(device, seeds.sub_seed(seed, seeds.ROWS, chunk))
    kw = dict(generator=gen, device=device, dtype=torch.float32)
    mixgen = seeds.generator(device, seeds.sub_seed(seed, seeds.MIX, 0))
    mix = (torch.randn((6, 10), generator=mixgen, device=device)
           * (torch.rand((6, 10), generator=mixgen, device=device) < 0.4))
    lat = torch.randn((n, 6), **kw)
    cont = lat @ mix + 0.3 * torch.randn((n, 10), **kw)
    cont[:, 0] = cont[:, 0] * 600 + 2800
    cont[:, 1] = cont[:, 1].abs() * 90
    wild = torch.nn.functional.one_hot(
        torch.randint(0, 4, (n,), generator=gen, device=device), 4)
    soil_id = torch.remainder(
        torch.trunc(lat[:, 0] * 6 + torch.randn((n,), **kw) + 20).long(), 40).clamp(0, 39)
    soil = torch.nn.functional.one_hot(soil_id, 40)
    x = torch.cat([cont, wild.to(torch.float32), soil.to(torch.float32)], 1).contiguous()
    if not labels:
        return x, None
    noise = torch.randn((n,), generator=seeds.generator(
        device, seeds.sub_seed(seed, seeds.LABELS, chunk)), device=device)
    score = ((cont[:, 0] - 2800) / 600 + 0.5 * (cont[:, 1] > 45) + 0.8 * lat[:, 1]
             + 0.3 * soil_id / 40 + 0.4 * noise)
    cuts = torch.quantile(score, torch.tensor(CLASS_QUANTILES, device=device))
    return x, torch.bucketize(score, cuts, right=True).to(torch.float32)
