"""Host-side CSR container, synthetic generators and the ``.mtx`` reader."""
