"""Frozen work counts and the table of peaks (the yardstick of the
rooflines and of the *_mfu shares)."""
