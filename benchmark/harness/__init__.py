"""The benchmark harness: spec, generator, window, trace, result."""
