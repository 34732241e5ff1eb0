"""The benchmark's own code: traffic, weights, spans, trace reading,
counts and the correctness check. Nothing here is part of the program
under test."""
