"""Fitting of the port: the RDF fit (SchNet and pair MLPs), the LJ pair
fit, their losses, optimizer, pretraining and checkpoints."""
