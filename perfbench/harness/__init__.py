"""The benchmark's own machinery: loading a cell by name, the result
line, host spans, the profiler window and its reading."""
