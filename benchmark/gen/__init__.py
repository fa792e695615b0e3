"""Genome and read generators of the benchmark: numpy only, made from the
run's seed, independent of the program under test."""
