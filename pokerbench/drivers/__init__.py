"""Traffic drivers, one module a kind of traffic, named by a cell's `driver`."""
