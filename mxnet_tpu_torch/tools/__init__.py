"""Microbenchmarks of the port whose logic the tests reach; the scripts
under ``tools/`` at the repository root run them."""
