"""The mesh executor (``executor``: lanes and vertices sharded over a grid
of devices) and fault tolerance (``fault``): the checkpoint/restart loop,
the straggler monitor and the supervised service driver."""
