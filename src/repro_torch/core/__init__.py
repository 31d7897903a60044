"""Sparse engine, embedding sources, dense engine and the DLRM model."""
