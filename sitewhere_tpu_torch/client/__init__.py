"""REST client (reference: sitewhere-client — ISiteWhereClient /
rest/client/SiteWhereClient.java:91)."""

from sitewhere_tpu_torch.client.rest import (SiteWhereClient,
                                             SiteWhereClientError)

__all__ = ["SiteWhereClient", "SiteWhereClientError"]
