"""Share of the traced pass's trials handed to the rescue tiers (tier 1,
and tier 2 for those tier 1 lost), in percent of the batch."""


def read(rec):
    if not rec.get("has_rescue") or "rerun" not in rec:
        return None
    return 100.0 * rec["rerun"] / rec["B"]
