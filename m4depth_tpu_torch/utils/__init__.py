"""Logging, profiling and tracing helpers of the harness."""
