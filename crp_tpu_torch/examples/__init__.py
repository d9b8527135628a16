"""Training through the engines: a 2-layer GCN (``gcn_train``) and a
2-layer GAT with trainable edge weights (``gat_train``), each runnable with
``python -m`` and importable (``train(...)``)."""
