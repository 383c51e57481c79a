"""The two-party MPC substrate: transport, pre-processing, the fabric and
the device share plane."""
