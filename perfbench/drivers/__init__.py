"""One module a benchmark entry, named in a cell's ``driver`` key: each
defines ``Driver(cell, config, seed, device, hooks)``."""
