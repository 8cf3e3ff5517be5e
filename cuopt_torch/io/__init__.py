"""Input readers of the port: `vrp` (Solomon / CVRPLIB routing instances
and the synthetic Gehring-Homberger-class generator). The MPS readers of
cuopt_tpu/io come with the port's API surface."""
