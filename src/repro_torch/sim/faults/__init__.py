"""Fault layer of the port: only the zero counters for now (see
``inject.py``); fault injection itself is a later slice."""
