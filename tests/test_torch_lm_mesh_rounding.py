"""rwkv6 on a ``(1, 4)`` mesh with 8 heads a rank, as rwkv6-1.6b's 32 heads
split at full width, against one device with its products computed in the
mesh's blocks (``chip_smoke.blocks_matched``), on the CPU.

The reduced rwkv6 holds 4 heads, one a rank on (1, 4), so a fault in how a
rank orders several heads (the WKV's state, ``u``, ``w0``, ``ln_x``'s
block) would not show in ``tests/test_torch_lm_mesh_families.py``.  Here
the config is widened to 32 heads (d_model 512, head_dim 16).  One device
and the mesh round their products alike only when the products have the
same shapes and the same thread count (a product's blocking, and so its
rounding, follows both): ``blocks_matched`` splits the one device's
products into the ranks' column and row blocks, and the one-device run
happens inside rank 0 of the gloo world, whose processes share the thread
count.  Then every rank's WKV inputs and outputs of layer 0 (r, k, v, the
decay w, the bonus u, the output y and the state) are the one device's
for the rank's heads to the bit.  What is left between the two is the
order of the mesh's float32 all-reduce, which reaches the residual stream
after layer 0; the logits are held at the family's logit bound (0.125).
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.models.rwkv6 as R
from repro_torch.configs import get_reduced
from repro_torch.gbdt.distributed import run_ranks
from repro_torch.launch.mesh import RankMesh
from repro_torch.models import get_model

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import blocks_matched  # noqa: E402  (the card's [lm-mesh] gate uses it)

SHAPE = (1, 4)
B, S = 2, 80  # two of the WKV's 64-token chunks
LOGIT_ATOL = 0.125


def _cfg():
    return dataclasses.replace(get_reduced("rwkv6-1.6b"), d_model=512, n_heads=32,
                               n_kv_heads=32, head_dim=16, d_ff=256, n_layers=2)


def _run(cfg, params, tokens, mesh=None) -> dict:
    """Prefill with layer 0's WKV inputs and outputs recorded."""
    seen = {}
    wkv = R.wkv

    def recording(r, k, v, w, u, state):
        y, s = wkv(r, k, v, w, u, state)
        if not seen:
            seen.update({n: t.float().numpy().copy() for n, t in
                         dict(r=r, k=k, v=v, w=w, u=u, y=y, state=s).items()})
        return y, s

    R.wkv = recording
    try:
        with torch.no_grad():
            logits, _ = get_model(cfg, "cpu").prefill(params, {"tokens": tokens}, mesh=mesh)
    finally:
        R.wkv = wkv
    return {**seen, "logits": logits.numpy()}


def _world(rank, device, tokens):
    cfg = _cfg()
    mesh = RankMesh(SHAPE, device_type="cpu")
    out = {"coords": mesh.coords,
           "mesh": _run(cfg, get_model(cfg, "cpu").init(0, mesh=mesh), tokens, mesh)}
    if rank == 0:  # one device, in a rank's process: the ranks' thread count
        params = get_model(cfg, "cpu").init(0)
        with blocks_matched(cfg, params, SHAPE[1]) as mode:
            out["one"] = _run(cfg, params, tokens)
        out["hits"] = mode.hits
    return out


@pytest.fixture(scope="module")
def world():
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (B, S)))
    return run_ranks(_world, 4, tokens, device="cpu")


def test_every_rank_holds_its_heads_wkv_to_the_bit(world):
    one = world[0]["one"]
    assert world[0]["hits"] == 2 * 9 + 1  # 9 split products a layer and the head
    per_rank = 32 // SHAPE[1]
    for r in world:
        heads = slice(r["coords"]["model"] * per_rank, (r["coords"]["model"] + 1) * per_rank)
        for n in ("r", "k", "v", "w", "y"):
            assert np.array_equal(r["mesh"][n], one[n][:, :, heads]), n
        assert np.array_equal(r["mesh"]["u"], one["u"][heads])
        assert np.array_equal(r["mesh"]["state"], one["state"][:, heads])


def test_the_logits_are_the_one_devices_within_the_family_bound(world):
    one = world[0]["one"]["logits"]
    vocab = _cfg().vocab
    for r in world:
        assert np.abs(r["mesh"]["logits"][:, :vocab] - one[:, :vocab]).max() <= LOGIT_ATOL
