"""Tensorization of a NodeInfo snapshot and the state carried to the scan."""
