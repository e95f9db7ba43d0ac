"""Drivers of the kinds of traffic, one module per kind, each with
``run(ctx) -> posebench.run.Result``; a cell's workload file names its
kind and holds its parameters."""
