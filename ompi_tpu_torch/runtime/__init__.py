"""Runtime: the init/finalize state machine."""
