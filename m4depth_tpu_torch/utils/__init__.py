"""Logging and profiling helpers of the harness."""
