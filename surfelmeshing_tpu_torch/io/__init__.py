"""Host-side input and output of the port."""
