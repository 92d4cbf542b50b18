"""Accuracy protocol: sequence generator, statistics, trial collector."""
