"""Placement of the sharded engines' feeds and read-only state on a DeviceMesh."""
