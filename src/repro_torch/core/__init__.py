"""The ToaD stream: bit I/O, the memory layout, memory accounting, the
staged compression pipeline (specs, stages, reports, budget search), the
codebooks and the tree-order bound tables (host-side numpy, identical
bytes to ``repro.core``)."""

from repro_torch.core.bitio import BitReader, BitWriter, StreamBoundsError, bits_for
from repro_torch.core.layout import (
    DecodedModel,
    EncodedModel,
    PackedEnsemble,
    StreamOffsets,
    decode,
    encode,
    from_packed,
    metadata_bits,
    select_width,
    stream_offsets,
    to_packed,
    used_threshold_values,
)
from repro_torch.core.memory import (
    compression_summary,
    packed_resident_bytes,
    reuse_factor,
    stream_sections,
    toad_bits_host,
)
from repro_torch.core.pipeline import (
    CompressionReport,
    CompressionSpec,
    CompressionStage,
    codebook_thresholds,
    default_ladder,
    get_stage,
    list_stages,
    probe_inputs,
    register_stage,
    run_pipeline,
    search_budget,
)
from repro_torch.core.treeorder import (
    reachable_leaf_mask,
    remaining_mass,
    suffix_bound,
    tree_mass,
    tree_max_step,
    tree_order_most_informative,
)
