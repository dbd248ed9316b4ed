"""Launchers (port of ``repro.launch``): ``launch.train``, the meshes
(``launch.mesh``), the dry run over every cell (``launch.dryrun``) and
its hillclimb (``launch.hillclimb``)."""
