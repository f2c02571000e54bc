"""The benchmark's harness: cells found by name, the jobs that run them, the
trace reading and the result line."""
