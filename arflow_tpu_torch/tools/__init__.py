"""Offline tools of the port: the GMM penalty fit (``penalty_em``)."""
