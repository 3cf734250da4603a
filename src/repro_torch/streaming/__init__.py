"""Streaming layer of the port: sgt streams, generators, the service."""
