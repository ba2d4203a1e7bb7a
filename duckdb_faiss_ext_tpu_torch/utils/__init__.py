"""Runtime configuration, timing and kernel builds."""
