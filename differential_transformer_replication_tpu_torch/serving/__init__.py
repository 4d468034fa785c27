"""Serving stack of the PyTorch port: request types, the scheduler copy,
the contiguous-pool continuous-batching engine, and its runner, client
and HTTP front-end."""
