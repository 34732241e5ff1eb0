"""Plain PyTorch references of what the benchmark's cells run. They import
nothing of the program under test."""
