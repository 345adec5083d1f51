"""Data helpers of the port: lattice constants and the water RDF targets."""
