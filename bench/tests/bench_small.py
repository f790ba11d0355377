"""Small sizes of the three cells, for runs of the harness on the CPU."""

FIT = {"config": {"rows": 4096, "n_features": 16, "n_bins": 32,
                  "gbdt": {"n_rounds": 3, "max_depth": 3},
                  "inputs": {"chunk_rows": 2048, "edge_sample_rows": 1024}},
       "traffic": {"check_fits": 2}}
SCORE_TRAFFIC = {"pool_rows": 8192, "min_rows": 64, "max_rows": 1024, "sizes": 8,
                 "backend": "packed"}
COVTYPE = {"config": {"inputs": {"edge_sample_rows": 2048}, "forest": {"n_trees": 42}},
           "traffic": SCORE_TRAFFIC}
TOAD_SCORE = {"config": {"forest": {"n_trees": 16}}, "traffic": SCORE_TRAFFIC}

CELLS = {"toad_gbdt-fit": FIT, "covtype_multi-score": COVTYPE, "toad_gbdt-score": TOAD_SCORE}

from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
