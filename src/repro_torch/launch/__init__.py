"""Entry points of the port (``python -m repro_torch.launch.serve``,
``.train``, ``.dryrun``, ``.perf``), the mesh constructors, the dry run's
cells and the roofline over its records."""
