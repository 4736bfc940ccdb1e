"""The harness: traffic, weights, loops, trace, reference and checks."""
