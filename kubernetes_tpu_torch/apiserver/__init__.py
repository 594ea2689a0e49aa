"""HTTP API server: the store over REST and watch streams, behind the
authentication, audit and authorization filters, over TLS when asked."""

from .server import APIServer, TLSConfig
