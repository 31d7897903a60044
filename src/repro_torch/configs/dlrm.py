"""DLRM configurations of paper Table I.

| Model   | # Tables | Gathers/table | Table size | MLP (Table I) | MLP weights here, fp32 |
|---------|----------|---------------|------------|---------------|------------------------|
| DLRM(1) | 5        | 20            | 128 MB     | 57.4 KB       | 1.21 MB                |
| DLRM(2) | 50       | 20            | 1.28 GB    | 57.4 KB       | 3.79 MB                |
| DLRM(3) | 5        | 80            | 128 MB     | 57.4 KB       | 1.21 MB                |
| DLRM(4) | 50       | 80            | 1.28 GB    | 57.4 KB       | 3.79 MB                |
| DLRM(5) | 50       | 80            | 3.2 GB     | 57.4 KB       | 3.79 MB                |
| DLRM(6) | 5        | 2             | 128 MB     | 557 KB        | 4.52 MB                |

Table size = n_tables * rows * 32 dims * 4 B. The MLP widths below are
the reference's; their weights and biases in fp32 are the last column,
not Table I's MLP size. The heterogeneous-table inventories are not
ported yet (ROADMAP Queue 1, item 8).
"""
from repro_torch.configs.base import DLRMConfig

DLRM_CONFIGS = {
    "dlrm1": DLRMConfig(name="dlrm1", n_tables=5, rows_per_table=200_000,
                        lookups_per_table=20,
                        bottom_mlp=(512, 256, 32), top_mlp=(512, 256, 1)),
    "dlrm2": DLRMConfig(name="dlrm2", n_tables=50, rows_per_table=200_000,
                        lookups_per_table=20,
                        bottom_mlp=(512, 256, 32), top_mlp=(512, 256, 1)),
    "dlrm3": DLRMConfig(name="dlrm3", n_tables=5, rows_per_table=200_000,
                        lookups_per_table=80,
                        bottom_mlp=(512, 256, 32), top_mlp=(512, 256, 1)),
    "dlrm4": DLRMConfig(name="dlrm4", n_tables=50, rows_per_table=200_000,
                        lookups_per_table=80,
                        bottom_mlp=(512, 256, 32), top_mlp=(512, 256, 1)),
    "dlrm5": DLRMConfig(name="dlrm5", n_tables=50, rows_per_table=500_000,
                        lookups_per_table=80,
                        bottom_mlp=(512, 256, 32), top_mlp=(512, 256, 1)),
    # heavyweight MLP (4.52 MB of fp32 weights here), tiny embedding stage
    "dlrm6": DLRMConfig(name="dlrm6", n_tables=5, rows_per_table=200_000,
                        lookups_per_table=2,
                        bottom_mlp=(1024, 512, 32), top_mlp=(1024, 512, 1)),
}

# Small variant for smoke tests.
DLRM_SMOKE = DLRMConfig(name="dlrm_smoke", n_tables=3, rows_per_table=1000,
                        lookups_per_table=4, emb_dim=16,
                        bottom_mlp=(64, 16), top_mlp=(64, 1))
