"""Compute kernels: device kernels with numpy references.

Every device kernel here has a numpy oracle in the same module (or a
``*_np`` sibling) used by the test-suite — mirroring the reference's
test/test-refine.py strategy of validating native kernels against plain
NumPy reimplementations.
"""
