"""Host-side utilities of the control loop."""
