"""Engine/data-loader integrations (reference paimon-python engines:
pypaimon/ray/, pypaimon/daft/, plus the JVM connectors' role).

Counterpart of paimon_tpu/integrations/.

- torch_data:  PyTorch IterableDataset / DataLoader over table scans
- jax_data:    fixed-shape batches of tensors on the table's device
- ray_data:    Ray Datasets adapter (gated on ray being installed)
- daft_data:   Daft DataFrame adapter (gated on daft being installed)
"""
