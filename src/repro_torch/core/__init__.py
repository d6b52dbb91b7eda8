"""The paper's contribution on PyTorch: butterfly schedules (butterfly.py),
their replay over simulated ranks (collectives.py), packed-bitmap frontiers
(frontier.py), and the distributed ButterFly BFS engine (bfs.py)."""
