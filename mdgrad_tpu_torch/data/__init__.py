"""Data helpers of the port: lattice constants and the RDF targets
(``registry``); the supervised datasets, padded loaders, bonded
topologies, sparse converters and crystal graphs of the
neural-force-field stack."""
