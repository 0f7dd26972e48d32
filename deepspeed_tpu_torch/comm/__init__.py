"""Communication-side numerics of the port: the blockwise int8 core."""
