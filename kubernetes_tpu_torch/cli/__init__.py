"""CLI layer (kubectl capability; SURVEY.md L8)."""

from .kubectl import Kubectl, main
