"""HTTP API server: the store over REST and watch streams."""

from .server import APIServer
