"""Fault tolerance of the port (``fault``): the checkpoint/restart loop,
the straggler monitor and the supervised service driver."""
