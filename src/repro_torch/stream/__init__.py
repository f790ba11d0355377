"""Streaming ``.toad`` artifacts of the port: block-aligned layout +
progressive serving (the JAX package's ``repro.stream``, module for
module).

The classic ``.toad`` bundle is an npz loaded all-or-nothing, so a fleet
rollout pays full decode latency per model before its first prediction.
This package adds the PACSET-style (arxiv 2011.05383) streaming container
and the anytime-inference serving path on top of it:

* :mod:`repro_torch.stream.format` — the ``.toadpack`` v4 container: fixed-offset
  manifest, then the stream header (feature map + threshold/leaf
  codebooks), then ``TREE_BLOCK``-tree blocks, byte-aligned and
  individually sha256-checksummed, then the eval fingerprint.  Trees are
  permuted most-informative-first (descending per-tree leaf-value mass) and
  the permutation is recorded in the manifest.
* :mod:`repro_torch.stream.reader` — :class:`BlockReader` (mmap/chunked lazy
  block decode) and :func:`open_streaming` (manifest + codebooks validated
  up front; v1-v3 npz bundles fall back to ``load_checked``).
* :mod:`repro_torch.stream.progressive` — :class:`ProgressiveScorer`: partial
  boosted sums that answer after the first block and converge to the
  classic-path predictions once every block has landed (arxiv 2306.09789's
  anytime property), evaluated on the streaming model's device.
"""

from repro_torch.stream.format import (
    PACK_FORMAT_VERSION,
    PACK_MAGIC,
    TREE_BLOCK,
    read_manifest,
    tree_order_most_informative,
    write_pack,
)
from repro_torch.stream.progressive import (
    ProgressiveModel,
    ProgressiveResult,
    ProgressiveScorer,
)
from repro_torch.stream.reader import BlockReader, StreamingError, open_streaming

__all__ = [
    "PACK_FORMAT_VERSION",
    "PACK_MAGIC",
    "TREE_BLOCK",
    "BlockReader",
    "ProgressiveModel",
    "ProgressiveResult",
    "ProgressiveScorer",
    "StreamingError",
    "open_streaming",
    "read_manifest",
    "tree_order_most_informative",
    "write_pack",
]
