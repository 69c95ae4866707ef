"""CRUSH placement: map model, hashes, rule VM, kernel, scalar spec."""
