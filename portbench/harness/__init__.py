"""The benchmark's general code: the run, the device readings, the probes,
the roofline arithmetic and the plain references."""
