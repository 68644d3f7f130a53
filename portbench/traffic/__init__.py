"""Traffic kinds: ``<kind>.py`` drives the program under a mix's
parameters (``mixes/<traffic>.json`` names its ``kind``)."""
