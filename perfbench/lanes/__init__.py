"""One driver per entry point of the program, found by the traffic's
``lane``: ``run(ctx) -> record`` (``perfbench.harness``)."""
