"""Sharded serving over a ("data", "model") process mesh: the layouts
(sharding.py), the ranks (launch.py) and the multi-rank dry run
(dryrun.py)."""
