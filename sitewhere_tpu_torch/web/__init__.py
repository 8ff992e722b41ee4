"""REST gateway (reference: service-web-rest — 27 Spring MVC controllers,
JWT auth filter, Swagger). Here: a dependency-free HTTP tier on the stdlib
threading HTTP server, JSON marshaling of the model dataclasses, JWT bearer
auth, and controllers registered against a tiny router."""

from sitewhere_tpu_torch.web.router import Request, Router
from sitewhere_tpu_torch.web.server import RestServer

__all__ = ["Request", "Router", "RestServer"]
