"""End-to-end training: optimizer, train step, metrics, checkpoints, fit."""
