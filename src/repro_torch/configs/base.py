"""Config schema: the DLRM family (paper Table I).

A frozen dataclass, field for field the reference's ``DLRMConfig``, so a
config built in either package describes the same model.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm"
    n_tables: int = 5
    rows_per_table: int = 200_000
    emb_dim: int = 32                 # paper default: 32-dim embeddings
    lookups_per_table: int = 20       # gathers per table ("M" in Fig. 2)
    dense_features: int = 13          # criteo-style continuous features
    bottom_mlp: Tuple[int, ...] = (512, 256, 32)
    top_mlp: Tuple[int, ...] = (512, 256, 1)
    dtype: str = "float32"
    # Heterogeneous tables: each table t owns a private
    # (table_rows[t] + 1, table_dims[t]) arena and draws its ids from
    # Zipf(table_alphas[t]). All three tuples have n_tables entries.
    table_rows: Optional[Tuple[int, ...]] = None
    table_dims: Optional[Tuple[int, ...]] = None
    table_alphas: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        for f in ("table_rows", "table_dims", "table_alphas"):
            v = getattr(self, f)
            if v is not None and len(v) != self.n_tables:
                raise ValueError(f"{f} has {len(v)} entries for "
                                 f"{self.n_tables} tables")
        if (self.table_rows is None) != (self.table_dims is None):
            raise ValueError("heterogeneous configs set table_rows AND "
                             "table_dims together")

    @property
    def heterogeneous(self) -> bool:
        return self.table_rows is not None

    @property
    def resolved_table_rows(self) -> Tuple[int, ...]:
        return (self.table_rows if self.table_rows is not None
                else (self.rows_per_table,) * self.n_tables)

    @property
    def resolved_table_dims(self) -> Tuple[int, ...]:
        return (self.table_dims if self.table_dims is not None
                else (self.emb_dim,) * self.n_tables)

    @property
    def table_bytes(self) -> int:
        if self.heterogeneous:
            return 4 * sum(r * d for r, d in zip(self.table_rows,
                                                 self.table_dims))
        return self.n_tables * self.rows_per_table * self.emb_dim * 4

    @property
    def n_interact_features(self) -> int:
        # reduced embedding per table + bottom-mlp output vector
        return self.n_tables + 1
