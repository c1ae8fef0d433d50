// Jump Point Search on a 2-D 8-connected occupancy grid.
//
// Native front-end search for the TPU planning stack -- fills the role of
// the reference front_end/src/jps_planner/graph_search.cpp (JPS with
// forced-neighbor pruning over an ESDF-thresholded grid).  Clean-room
// implementation of Harabor & Grastien's canonical JPS; the caller
// pre-thresholds the ESDF at the safe distance into a blocked mask,
// mirroring isOccWithSafeDis semantics.
//
// C API (ctypes-friendly):
//   jps_plan(blocked, H, W, sx, sy, gx, gy, out_xy, max_pts) -> n_pts
//     blocked : uint8[H*W], row-major, x = row index (matches SDFmap's
//               x-major layout), nonzero = untraversable
//     returns the number of path cells written to out_xy (pairs of int32,
//     from start to goal, jump points only), 0 if no path, -1 on error.
//
// Build: g++ -O3 -shared -fPIC -o libjps.so jps.cpp

#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>
#include <cmath>
#include <algorithm>

namespace {

struct Node {
  int x, y;
  int dx, dy;       // arrival direction
  float g, f;
  int parent;       // index into pool
};

struct PQItem {
  float f;
  int idx;
  bool operator<(const PQItem& o) const { return f > o.f; }  // min-heap
};

inline bool blockedAt(const uint8_t* b, int H, int W, int x, int y) {
  if (x < 0 || y < 0 || x >= H || y >= W) return true;
  return b[x * W + y] != 0;
}

inline float octile(int dx, int dy) {
  int ax = std::abs(dx), ay = std::abs(dy);
  return (float)(std::max(ax, ay) - std::min(ax, ay)) +
         1.41421356f * (float)std::min(ax, ay);
}

struct Searcher {
  const uint8_t* b;
  int H, W, gx, gy;

  bool walk(int x, int y) const { return !blockedAt(b, H, W, x, y); }

  // Does (x,y), arrived at via (dx,dy), have a forced neighbor?
  bool hasForced(int x, int y, int dx, int dy) const {
    if (dx != 0 && dy != 0) {  // diagonal
      if (!walk(x - dx, y) && walk(x - dx, y + dy)) return true;
      if (!walk(x, y - dy) && walk(x + dx, y - dy)) return true;
    } else if (dx != 0) {      // vertical move in x
      if (!walk(x, y + 1) && walk(x + dx, y + 1)) return true;
      if (!walk(x, y - 1) && walk(x + dx, y - 1)) return true;
    } else {                   // horizontal move in y
      if (!walk(x + 1, y) && walk(x + 1, y + dy)) return true;
      if (!walk(x - 1, y) && walk(x - 1, y + dy)) return true;
    }
    return false;
  }

  // Jump from (x,y) in direction (dx,dy); returns true with jump point in
  // (jx,jy) if found.
  bool jump(int x, int y, int dx, int dy, int& jx, int& jy) const {
    int cx = x + dx, cy = y + dy;
    while (true) {
      if (!walk(cx, cy)) return false;
      // diagonal moves must not cut blocked corners
      if (dx != 0 && dy != 0 && !walk(cx - dx, cy) && !walk(cx, cy - dy))
        return false;
      if (cx == gx && cy == gy) { jx = cx; jy = cy; return true; }
      if (hasForced(cx, cy, dx, dy)) { jx = cx; jy = cy; return true; }
      if (dx != 0 && dy != 0) {
        int tx, ty;
        if (jump(cx, cy, dx, 0, tx, ty)) { jx = cx; jy = cy; return true; }
        if (jump(cx, cy, 0, dy, tx, ty)) { jx = cx; jy = cy; return true; }
      }
      cx += dx;
      cy += dy;
    }
  }

  // successors directions from node arrived via (dx,dy)
  int neighbors(int x, int y, int dx, int dy, int dirs[8][2]) const {
    int n = 0;
    if (dx == 0 && dy == 0) {  // start node: all 8
      static const int all[8][2] = {{1,0},{-1,0},{0,1},{0,-1},
                                    {1,1},{1,-1},{-1,1},{-1,-1}};
      for (int i = 0; i < 8; i++) {
        dirs[n][0] = all[i][0]; dirs[n][1] = all[i][1]; n++;
      }
      return n;
    }
    if (dx != 0 && dy != 0) {
      if (walk(x + dx, y)) { dirs[n][0] = dx; dirs[n][1] = 0; n++; }
      if (walk(x, y + dy)) { dirs[n][0] = 0; dirs[n][1] = dy; n++; }
      if (walk(x + dx, y + dy)) { dirs[n][0] = dx; dirs[n][1] = dy; n++; }
      if (!walk(x - dx, y) && walk(x - dx, y + dy)) {
        dirs[n][0] = -dx; dirs[n][1] = dy; n++;
      }
      if (!walk(x, y - dy) && walk(x + dx, y - dy)) {
        dirs[n][0] = dx; dirs[n][1] = -dy; n++;
      }
    } else if (dx != 0) {
      if (walk(x + dx, y)) { dirs[n][0] = dx; dirs[n][1] = 0; n++; }
      if (!walk(x, y + 1) && walk(x + dx, y + 1)) {
        dirs[n][0] = dx; dirs[n][1] = 1; n++;
      }
      if (!walk(x, y - 1) && walk(x + dx, y - 1)) {
        dirs[n][0] = dx; dirs[n][1] = -1; n++;
      }
    } else {
      if (walk(x, y + dy)) { dirs[n][0] = 0; dirs[n][1] = dy; n++; }
      if (!walk(x + 1, y) && walk(x + 1, y + dy)) {
        dirs[n][0] = 1; dirs[n][1] = dy; n++;
      }
      if (!walk(x - 1, y) && walk(x - 1, y + dy)) {
        dirs[n][0] = -1; dirs[n][1] = dy; n++;
      }
    }
    return n;
  }
};

}  // namespace

extern "C" {

int jps_plan(const uint8_t* blocked, int H, int W,
             int sx, int sy, int gx, int gy,
             int32_t* out_xy, int max_pts) {
  if (!blocked || !out_xy || H <= 0 || W <= 0) return -1;
  if (blockedAt(blocked, H, W, sx, sy) || blockedAt(blocked, H, W, gx, gy))
    return 0;
  if (sx == gx && sy == gy) {
    if (max_pts < 1) return -1;
    out_xy[0] = sx; out_xy[1] = sy;
    return 1;
  }

  Searcher S{blocked, H, W, gx, gy};

  std::vector<Node> pool;
  pool.reserve(4096);
  std::vector<float> best(H * W, 1e30f);
  std::priority_queue<PQItem> open;

  pool.push_back(Node{sx, sy, 0, 0, 0.f, octile(gx - sx, gy - sy), -1});
  best[sx * W + sy] = 0.f;
  open.push(PQItem{pool[0].f, 0});

  int goal_idx = -1;
  while (!open.empty()) {
    PQItem top = open.top();
    open.pop();
    Node cur = pool[top.idx];
    if (top.f > pool[top.idx].f + 1e-6f) continue;  // stale
    if (cur.x == gx && cur.y == gy) { goal_idx = top.idx; break; }

    int dirs[8][2];
    int nd = S.neighbors(cur.x, cur.y, cur.dx, cur.dy, dirs);
    for (int i = 0; i < nd; i++) {
      int jx, jy;
      if (!S.jump(cur.x, cur.y, dirs[i][0], dirs[i][1], jx, jy)) continue;
      float ng = cur.g + octile(jx - cur.x, jy - cur.y);
      if (ng + 1e-6f < best[jx * W + jy]) {
        best[jx * W + jy] = ng;
        float f = ng + octile(gx - jx, gy - jy);
        pool.push_back(Node{jx, jy, dirs[i][0], dirs[i][1], ng, f,
                            top.idx});
        open.push(PQItem{f, (int)pool.size() - 1});
      }
    }
  }

  if (goal_idx < 0) return 0;

  // backtrack
  std::vector<std::pair<int,int>> rev;
  for (int i = goal_idx; i >= 0; i = pool[i].parent)
    rev.emplace_back(pool[i].x, pool[i].y);
  int n = (int)rev.size();
  if (n > max_pts) return -1;
  for (int i = 0; i < n; i++) {
    out_xy[2 * i] = rev[n - 1 - i].first;
    out_xy[2 * i + 1] = rev[n - 1 - i].second;
  }
  return n;
}

}  // extern "C"
