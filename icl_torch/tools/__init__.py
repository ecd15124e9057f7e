"""Measuring scripts of the port; they run on the GPU only."""
