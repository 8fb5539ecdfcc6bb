"""Runtime services of the port: checkpointing (``checkpoint``)."""
