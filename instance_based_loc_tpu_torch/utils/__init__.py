"""Host utilities: logging, metrics, PLY and PNG I/O, stage timing."""
