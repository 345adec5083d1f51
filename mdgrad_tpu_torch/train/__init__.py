"""Fitting of the port: losses and the RDF fit's epoch loss and update."""
