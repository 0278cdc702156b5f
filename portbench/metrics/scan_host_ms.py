"""Ms per scan call in the scan driver outside its chunks
(scan/driver.Scanner: reading, buckets, stacking, records)."""


def read(rec):
    s = rec.get("spans", {})
    if not s.get("call"):
        return None
    rest = sum(s["call"]) - sum(s.get("posteriors", [])) \
        - sum(s.get("cyk", []))
    return 1e3 * rest / len(s["call"])
