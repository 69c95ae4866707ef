"""Device selection, kernel build, timing, bounds and perf counters."""
