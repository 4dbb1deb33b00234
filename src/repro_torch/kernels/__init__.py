"""Hand-written kernels for Hopper, their launch wrappers and plain versions."""
