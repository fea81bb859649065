"""Most pages in use after any tick of the window, over the pool's pages
(%)."""


def read(run):
    pages = [t.pages for t in run.ticks if t.pages is not None]
    if not pages or not run.pool_pages:
        return None
    return 100.0 * max(pages) / run.pool_pages
