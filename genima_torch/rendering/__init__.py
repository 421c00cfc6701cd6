"""Sphere-target rendering of RLBench-layout datasets (``render_data``)."""
