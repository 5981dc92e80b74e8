"""The steady-state step of the reference."""
