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
not Table I's MLP size.

Also the heterogeneous-table inventories of Centaur's workload
characterization: per-table vocab sizes and access skew vary by orders of
magnitude, so the sparse stage is many independent gather-reduce
streams. ``make_heterogeneous`` draws one from a seed with the
reference's numpy draws, so both packages get the same inventory.
"""
import numpy as np

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


def make_heterogeneous(name: str, n_tables: int, *, seed: int = 0,
                       min_rows: int = 2_000, max_rows: int = 500_000,
                       dims=(8, 16, 32, 64), emb_dim: int = 32,
                       lookups_per_table: int = 20,
                       bottom_mlp=(512, 256, 32),
                       top_mlp=(512, 256, 1)) -> DLRMConfig:
    """Draw a Centaur-style heterogeneous table inventory: vocab sizes
    log-uniform over [min_rows, max_rows], embedding dims from `dims`,
    and a per-table Zipf skew alpha in [1.02, 1.3]. Deterministic in
    `seed`."""
    rng = np.random.RandomState(seed)
    rows = np.exp(rng.uniform(np.log(min_rows), np.log(max_rows),
                              n_tables)).astype(np.int64)
    table_dims = rng.choice(dims, n_tables)
    alphas = rng.uniform(1.02, 1.3, n_tables)
    return DLRMConfig(
        name=name, n_tables=n_tables,
        rows_per_table=int(rows.max()), emb_dim=emb_dim,
        lookups_per_table=lookups_per_table,
        bottom_mlp=tuple(bottom_mlp), top_mlp=tuple(top_mlp),
        table_rows=tuple(int(r) for r in rows),
        table_dims=tuple(int(d) for d in table_dims),
        table_alphas=tuple(float(a) for a in alphas))


# Heterogeneous inventories, kept out of DLRM_CONFIGS as in the reference
# (a helper that rescales rows_per_table would desync the row inventory).
# dlrm_het2: 26 tables of 2,307-223,260 rows, dims 8/16/32/64, 104.2 MB of
# fp32 rows.
DLRM_HET_CONFIGS = {
    "dlrm_het1": make_heterogeneous("dlrm_het1", 8, seed=1),
    "dlrm_het2": make_heterogeneous("dlrm_het2", 26, seed=2,
                                    lookups_per_table=38),
}

# Heterogeneous smoke config: hand-picked extremes (a big skewed table, a
# mid table, a tiny near-uniform one), mixed dims and vocabs, no draws.
DLRM_HET_SMOKE = DLRMConfig(
    name="dlrm_het_smoke", n_tables=3, rows_per_table=2000,
    lookups_per_table=4, emb_dim=16, bottom_mlp=(64, 16), top_mlp=(64, 1),
    table_rows=(2000, 150, 9), table_dims=(16, 8, 4),
    table_alphas=(1.2, 1.05, 1.02))
